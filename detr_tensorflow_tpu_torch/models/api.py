"""Model construction API (port of ``detr_tensorflow_tpu/models/api.py``).

``build_detr`` makes a ``DETR`` on a device (the card unless the caller
asks for another), with weights drawn from a ``torch.Generator`` seeded by
``seed`` or loaded from a local checkpoint (``weights.load_weights``: the
JAX package's ``.npz``, a facebook or HuggingFace torch state_dict, or a
short name), and the backbone optionally from a torchvision ResNet;
``DetrModel.save`` writes the JAX package's ``.npz``. ``get_detr_model``
keeps the reference's signature and its three head variants.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import weights as weights_lib
from .detr import DETR

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DETR_HEAD_PREFIXES = ("class_embed.", "bbox_embed.")
_MASK_PREFIXES = ("mask_head.", "bbox_attention.")


class DetrModel:
    """A model bundle: the ``DETR`` module, its input normalization
    (``"torch_resnet"`` or ``"tf_resnet"``) and its device. Calling it runs
    the forward under ``torch.inference_mode``."""

    def __init__(self, module: DETR, normalized_method: str = "torch_resnet"):
        self.module = module.eval()
        self.normalized_method = normalized_method

    @property
    def device(self) -> torch.device:
        return self.module.query_embed.device

    def __call__(self, images, pixel_mask=None):
        with torch.inference_mode():
            return self.module(images, pixel_mask)

    def save(self, path: str) -> None:
        """Save the model as the JAX package's ``.npz`` (its
        ``DetrModel.save`` format: ``params``, ``frozen`` and, once the int8
        backbone is filled, ``quant``), which ``build_detr(weights=path)``
        and ``load`` here, and the JAX package's ``load_weights``, read
        back."""
        variables = weights_lib.to_jax_variables(self.module.state_dict())
        quant = self.module.backbone_quant
        if quant is not None and quant.loaded:
            variables["quant"] = {"backbone": weights_lib.to_jax_quant(dict(quant.named_buffers()))}
        weights_lib.save_variables_npz(variables, path)

    def load(self, path_or_name: str) -> "DetrModel":
        """Replace every parameter and buffer from a local checkpoint (any
        file or name ``weights.load_weights`` takes); an ``.npz`` with the
        "quant" collection fills the int8 backbone too. Every cached cast
        and fold is dropped, as by ``load_state_dict``."""
        _load_weights(self.module, path_or_name, "all")
        return self


def init_weights(module: DETR, generator: torch.Generator) -> None:
    """Seeded initialisation, in parameter order: Linear and Conv weights
    normal with variance 1/fan_in (flax's lecun normal, untruncated),
    biases zero, LayerNorm one/zero, ``query_embed`` standard normal.
    FrozenBN buffers keep their identity statistics."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        module.query_embed.normal_(0.0, 1.0, generator=generator)


def _load_weights(module: DETR, name: str, heads: str) -> None:
    """Load ``name`` (``weights.load_weights``) into ``module``. ``heads``:
    "all" loads every tensor and needs each of them; "trunk" keeps fresh
    heads and loads the rest (the JAX ``build_detr``'s rule for a head
    other than "detr"). As in the JAX ``build_detr``, a segmentation head
    the checkpoint lacks (every detection checkpoint) keeps its values, and
    one the model lacks is not read."""
    tree = weights_lib.load_weights(
        name, backbone_depth=module.backbone_depth,
        num_encoder_layers=module.transformer.num_encoder_layers,
        num_decoder_layers=module.transformer.num_decoder_layers, model_dim=module.model_dim)
    quant = tree.pop("quant", None)
    state = weights_lib.from_jax_variables(tree)
    skip = _DETR_HEAD_PREFIXES + _MASK_PREFIXES if heads == "trunk" else ()
    if not module.masks:
        skip += _MASK_PREFIXES
    state = {k: v for k, v in state.items() if not k.startswith(skip)}
    missing, unexpected = module.load_state_dict(state, strict=False)
    # "quant" fills backbone_quant below.
    missing = [k for k in missing if not k.startswith(("backbone_quant.",) + _MASK_PREFIXES)]
    if unexpected or any(heads == "all" or not k.startswith(("cls_layer.", "pos_layer."))
                         for k in missing):
        raise ValueError(f"{name}: missing {missing}, unexpected {unexpected}")
    if module.backbone_quant is not None and quant is not None:
        module.backbone_quant.load(weights_lib.from_jax_quant(quant["backbone"]))


def _load_backbone_weights(module: DETR, path: str) -> None:
    """The backbone's parameters and FrozenBN statistics from a local
    torchvision ResNet checkpoint (``weights.load_backbone_weights``)."""
    tree = weights_lib.load_backbone_weights(path, depth=module.backbone_depth)
    state = {"backbone." + k: v for k, v in weights_lib.from_jax_variables(
        {c: tree[c]["backbone"] for c in ("params", "frozen")}).items()}
    expected = {k for k in module.state_dict() if k.startswith("backbone.")}
    if set(state) != expected:
        raise ValueError(f"{path}: missing {sorted(expected - set(state))}, unexpected "
                         f"{sorted(set(state) - expected)}")
    module.load_state_dict(state, strict=False)


def build_detr(num_classes: int = 92, num_queries: int = 100, head: str = "detr",
               nb_class: Optional[int] = None, num_encoder_layers: int = 6,
               num_decoder_layers: int = 6, backbone_depth: int = 50,
               backbone_stage_sizes=None, dilation: bool = False, dtype: str = "float32",
               attn_impl: str = "auto", weights: Optional[str] = None,
               backbone_weights: Optional[str] = None, seed: int = 42,
               normalized_method: str = "torch_resnet", device="cuda",
               **model_kwargs) -> DetrModel:
    """Construct a DETR bundle on ``device`` (the card by default; the CPU
    only when asked, ``device="cpu"``).

    ``dtype`` ("float32" or "bfloat16") is the compute dtype only: every
    parameter is float32 in every build, as the JAX package keeps its
    parameters, and each layer casts it at its use (``models/layers.py``).
    A bf16 model trains (``train.Trainer``) with float32 master weights and
    float32 Adam moments, and the int8 model's ``quantized.quantize_model``
    calibrates from its float32 backbone.

    ``dilation=True`` is the DC5 family (DETR-R50-DC5, DETR-R101-DC5): the
    last stage keeps stride 16 through dilated convolutions.

    ``weights`` is any local file or short name ``weights.load_weights``
    takes: the JAX package's ``.npz`` (with ``backbone_quant=True`` its
    "quant" collection, when present, fills the int8 backbone) or a facebook
    or HuggingFace torch DETR checkpoint. ``head="detr"`` loads every
    tensor; another head keeps the checkpoint's trunk with fresh heads.
    ``backbone_weights`` is a local torchvision ResNet checkpoint loaded
    into the backbone after ``weights`` (ImageNet initialization). Extra
    keyword args (model_dim, num_heads, dim_feedforward, dropout,
    backbone_quant, fuse_residual, fuse_bottleneck, remat, backbone_remat,
    masks) go to ``DETR``.

    ``masks=True`` builds the instance-segmentation model (``pred_masks``
    beside the boxes); its head loads from a segmentation checkpoint
    (facebook DETRsegm, HF ``DetrForSegmentation``, or the JAX package's
    ``.npz`` of a ``masks=True`` model) and keeps its seeded values under a
    detection checkpoint.

    ``fuse_residual=True, fuse_bottleneck=True`` is the JAX package's
    fused-backbone serving configuration (kernels D and E, inference
    only); its weights load as the unfused model's do.
    """
    module = DETR(
        num_classes=num_classes, num_queries=num_queries, head=head,
        nb_class=nb_class, num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers, backbone_depth=backbone_depth,
        backbone_stage_sizes=backbone_stage_sizes, dilation=dilation, dtype=DTYPES[dtype],
        attn_impl=attn_impl, **model_kwargs,
    )
    init_weights(module, torch.Generator().manual_seed(seed))
    if weights is not None:
        _load_weights(module, weights, "all" if head == "detr" else "trunk")
    if backbone_weights is not None:
        _load_backbone_weights(module, backbone_weights)
    module.to(device)
    return DetrModel(module, normalized_method=normalized_method)


def get_detr_model(config=None, include_top: bool = False,
                   nb_class: Optional[int] = None, weights: Optional[str] = None,
                   tf_backbone: bool = False, num_decoder_layers: int = 6,
                   num_encoder_layers: int = 6, **kwargs) -> DetrModel:
    """Reference-signature factory.

    * ``include_top=True``: 92-class heads;
    * ``include_top=False, nb_class=None``: headless (returns ``hs``);
    * ``include_top=False, nb_class=N``: fresh finetuning heads.

    ``tf_backbone=True`` selects the caffe-style ``tf_resnet`` input
    normalization.
    """
    head = "detr" if include_top else ("finetune" if nb_class is not None else "none")
    kwargs.setdefault("dtype", getattr(config, "compute_dtype", "float32"))
    kwargs.setdefault("attn_impl", getattr(config, "attn_impl", "auto"))
    kwargs.setdefault("num_queries", getattr(config, "num_queries", 100))
    kwargs.setdefault("backbone_depth", getattr(config, "backbone_depth", 50))
    kwargs.setdefault("dilation", getattr(config, "dilation", False))
    kwargs.setdefault("backbone_weights", getattr(config, "backbone_weights", None))
    return build_detr(
        head=head, nb_class=nb_class, weights=weights,
        num_encoder_layers=num_encoder_layers, num_decoder_layers=num_decoder_layers,
        normalized_method="tf_resnet" if tf_backbone else "torch_resnet", **kwargs,
    )
